"""Renderer, batch transfer and network factory."""
