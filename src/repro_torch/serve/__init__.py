"""Serving: paged continuous batching, step functions, page allocation."""
