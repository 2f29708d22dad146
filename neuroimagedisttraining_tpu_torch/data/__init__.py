"""Synthetic cohort, site partition, device-resident client stacks."""
