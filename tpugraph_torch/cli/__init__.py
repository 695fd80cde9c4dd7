"""Command-line entry points (port of ``tpugraph/cli``):
``python -m tpugraph_torch.cli.train`` and ``python -m
tpugraph_torch.cli.explain``."""
