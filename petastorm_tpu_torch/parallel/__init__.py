"""Loader, shuffling buffers and the device decode tail."""
