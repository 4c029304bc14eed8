"""Online serving: dynamic micro-batching over the teacher eval step,
exposed through a dependency-free JSON/HTTP server (the counterpart of
``multimodal_edema_prediction_tpu/serve``)."""
from .predictor import BatchingPredictor, PredictorStats, QueueFullError
from .server import make_server, serve_forever

__all__ = ["BatchingPredictor", "PredictorStats", "QueueFullError",
           "make_server", "serve_forever"]
