"""Environments of the port (the token-level MDP of the LLM learner)."""
