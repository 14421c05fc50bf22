"""Model layer of the port: configs, building blocks, attention, assembly."""
