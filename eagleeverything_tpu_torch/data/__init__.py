"""Synthetic data: the tutorial simulator and a biobank-sized cohort."""
