"""The harness: loading the cell's files, weights, the closed loop, the
window's snapshots, the profiler slice and the output check."""
