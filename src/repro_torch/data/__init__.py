"""Data pipeline of training (numpy only): the synthetic corpus, sequence
packing and 9:1 distill/pretrain batch mixing, copies of
``repro.data.synthetic``, ``repro.data.packing`` and ``repro.data.mixing``."""
from .mixing import mixed_batches, simple_batches  # noqa: F401
from .packing import EOS, pack_documents, shift_labels  # noqa: F401
from .synthetic import (BOS, OOD_TASKS, PAD, SEP, TASKS,  # noqa: F401
                        SyntheticCorpus)
