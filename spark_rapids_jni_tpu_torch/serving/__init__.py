"""The serving tier (the JAX package's serving/). Only the typed
front-door rejection is ported so far (``admission.AdmissionRejected``,
raised by a closed ``parallel.TaskExecutor``); the sessions, the
scheduler, the frontend and the fleet are ROADMAP A16."""

from .admission import AdmissionRejected

__all__ = ["AdmissionRejected"]
