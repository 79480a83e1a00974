"""Entry points that run the reference's example workloads end to end."""
