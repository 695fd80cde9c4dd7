"""``product_roofline.coo`` (kernels layer, %): the adjacency products'
least time over the device time launched under the program's
nn.aggregate and nn.aggregate.backward spans, in the traced job, in the
cells that train on the COO edge list; moves ``train_epochs_per_s.coo``."""

from gnnbench.span_readers import product_roofline as read  # noqa: F401
