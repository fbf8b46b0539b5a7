"""Applications built on the transforms."""
