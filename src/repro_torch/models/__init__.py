"""The port's model zoo: the dense transformer family (``transformer``),
its layers and attention, and the registry facade."""
