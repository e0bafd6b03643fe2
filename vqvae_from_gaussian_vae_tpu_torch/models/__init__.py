"""Backbones and the engine."""
