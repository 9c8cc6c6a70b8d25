"""Synthetic matrix generators."""
