"""Scenario and profiling tools for the port."""
