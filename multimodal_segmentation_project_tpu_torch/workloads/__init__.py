"""Command-line workloads of the port."""
