"""The port's model zoo: the dense transformer family (``transformer``),
the SSM family (``rwkv6``), their layers and attention, and the registry
facade."""
