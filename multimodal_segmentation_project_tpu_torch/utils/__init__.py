"""Experiment bookkeeping and end-of-run plots for the port's trainer."""
