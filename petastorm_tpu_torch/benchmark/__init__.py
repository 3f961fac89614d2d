"""Measurement helpers for the port's paths on the card."""
