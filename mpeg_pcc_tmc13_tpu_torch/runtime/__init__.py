"""Device pipeline orchestration and the round-trip entry point."""
