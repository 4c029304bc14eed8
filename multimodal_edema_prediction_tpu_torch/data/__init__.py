"""Data for the training path: synthetic cohort, meta, anchor dataset,
encode-once feature bank."""
