"""Synthetic training data of the LLM learner."""
