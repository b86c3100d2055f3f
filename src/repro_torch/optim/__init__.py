"""Optimizers, schedules and gradient compression for the trainer."""
