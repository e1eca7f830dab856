"""Noise schedules, diffusion frameworks and samplers."""
