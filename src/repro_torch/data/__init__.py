"""Data pipeline of training (numpy only): sequence packing and 9:1
distill/pretrain batch mixing, copies of ``repro.data.packing`` and
``repro.data.mixing``."""
from .mixing import mixed_batches, simple_batches  # noqa: F401
from .packing import EOS, pack_documents, shift_labels  # noqa: F401
