"""Core algorithms of the port (the serving side of the A3C LLM agent)."""
