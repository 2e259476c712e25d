"""Model components: the ocean substep and its runner."""
