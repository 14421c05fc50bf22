"""Core algorithms of the port: the A3C LLM learner and its serving side."""
