"""The port's elastic-training layer: so far the int8 error-feedback
gradient compression (:mod:`.compression`) that ``TrainConfig.
compress_grads`` applies.  Resharding, checkpoints, the elastic manager and
the failure model are ROADMAP §A10g."""
from . import compression  # noqa: F401
