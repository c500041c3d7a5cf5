"""Seeded synthetic inputs."""
