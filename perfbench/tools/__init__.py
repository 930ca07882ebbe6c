"""Diagnostic scripts run on the card by hand (not by the driver)."""
