"""Context-parallel decode over ``torch.distributed`` (the port's share of
``repro/distributed``)."""
