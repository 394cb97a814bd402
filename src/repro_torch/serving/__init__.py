"""Serving of the port: the continuous-batching engine (plain, predictor
and speculative modes), the legacy single-batch ``ServeEngine``, the
seeded sampling head, the speculative metrics and the async streaming
front (``AsyncServingEngine``)."""
from repro_torch.serving.config import EngineConfig  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    ContinuousBatchingEngine, GenerationResult, ServeEngine)
from repro_torch.serving.api import AsyncServingEngine, TokenEvent  # noqa: F401
from repro_torch.serving.sampling import GREEDY, SamplingParams  # noqa: F401
from repro_torch.serving.scheduler import RequestResult  # noqa: F401
from repro_torch.serving.spec_decode import SpecResult, spec_metrics  # noqa: F401
