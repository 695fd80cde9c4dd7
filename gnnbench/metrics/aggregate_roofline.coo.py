"""``aggregate_roofline.coo`` (kernels layer, %): the adjacency products'
least time over the device time of the kernels that ran them, in the
traced job of the cells that train on the COO edge list; moves
``train_epochs_per_s.coo``."""

from gnnbench.readers import aggregate_roofline as read  # noqa: F401
