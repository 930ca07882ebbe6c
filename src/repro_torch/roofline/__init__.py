"""Roofline terms of a dry-run cell: analytic model FLOPs, per-rank counts
of a step's products, bytes and collectives, against the H100's peaks."""
