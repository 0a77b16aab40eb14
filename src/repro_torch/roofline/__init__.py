"""Roofline: the cost model of a dry-run cell on an H100 and its reports."""
