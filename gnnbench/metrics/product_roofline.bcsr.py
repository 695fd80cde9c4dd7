"""``product_roofline.bcsr`` (kernels layer, %): the adjacency products'
least time over the device time launched under the program's
nn.aggregate and nn.aggregate.backward spans, in the traced job, in the
cells that train on ``--bcsr`` (jobs that pack a block-sparse
adjacency); moves ``train_epochs_per_s.bcsr``."""

from gnnbench.span_readers import product_roofline as read  # noqa: F401
