"""The port's elastic-training layer: the malleable training job
(:mod:`.manager`'s ``ElasticTrainer``), its checkpoints
(:mod:`.checkpoint`), resharding onto a new mesh (:mod:`.resharding`), the
failure model (:mod:`.failures`) and the int8 error-feedback gradient
compression (:mod:`.compression`) that ``TrainConfig.compress_grads``
applies.  Only the last is imported here: the train step imports it, and
the manager imports the train step."""
from . import compression  # noqa: F401
