"""The port's training layer: the synthetic token pipeline (:mod:`.data`,
a copy of the JAX package's), AdamW and its schedules (:mod:`.optimizer`)
and the train step (:mod:`.train_step`)."""
from . import data, optimizer, train_step  # noqa: F401
