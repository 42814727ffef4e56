"""Frozen copies of the yardstick's arithmetic and inputs."""
