"""Tuner cache of the port: the persistent JSON file that
``create_plan(tuning="auto")`` reads.  The tuner that fills it
(``tensorfft_tpu/tuning/tuner.py`` in the JAX package) is not ported yet."""

from tensorfft_tpu_torch.tuning.cache import TunerCache, default_cache_path

__all__ = ["TunerCache", "default_cache_path"]
