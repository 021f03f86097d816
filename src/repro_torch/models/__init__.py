"""Layers the port serves."""
