"""Data and fit plumbing of the image-classification CLIs."""
