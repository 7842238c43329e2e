"""The paper's experiment end to end (``repro.experiments``)."""
from .pipeline import ReproResult, run_pipeline, save_result  # noqa: F401
