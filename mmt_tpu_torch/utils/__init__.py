"""Utilities of the port: timers, hyperparameters, checks, visualizer."""
