"""Plain float32 references of the port's models, in plain torch: no JAX,
no ``tpugraph`` and no kernel of ``tpugraph_torch``."""
