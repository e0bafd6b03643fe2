"""Config registry, FLOP counts, weight conversion."""
