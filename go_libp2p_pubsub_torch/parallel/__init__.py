"""parallel: the port's sharded rollout (see the package docstring)."""
