"""Sharding: the FSDP × TP parameter layout and activation pins."""
