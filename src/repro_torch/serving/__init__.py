"""Continuous-batching serving of the port: the engine (plain, predictor
and speculative modes), the seeded sampling head and the speculative
metrics."""
from repro_torch.serving.config import EngineConfig  # noqa: F401
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: F401
from repro_torch.serving.sampling import GREEDY, SamplingParams  # noqa: F401
from repro_torch.serving.scheduler import RequestResult  # noqa: F401
from repro_torch.serving.spec_decode import SpecResult, spec_metrics  # noqa: F401
