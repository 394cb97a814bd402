"""Continuous-batching serving of the port."""
from repro_torch.serving.config import EngineConfig  # noqa: F401
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: F401
from repro_torch.serving.sampling import GREEDY, SamplingParams  # noqa: F401
