"""Always-on campaign serving: intake, admission, continuous batching.

The port's counterpart of ``stencil_tpu.serve``. The batch campaign
(``campaign/``) answers "run this fixed job list to completion"; this
package turns the same driver into a persistent daemon: jobs arrive as file
drops while slots are running, admission control prices deadlines from the
performance ledger (``obs/ledger``), retired lanes are backfilled from a
live queue with no slot-wide barrier, and a killed daemon revives from
``serve-state.json`` owing exactly the jobs it had admitted but not
retired. ``apps/serve.py`` is the CLI front-end; a slot runs on one device
(the card unless ``device="cpu"``). It exports what the JAX package's
``serve`` does, and the files it writes (job drops, ``serve-state.json``,
``results/``, ledger entries, telemetry records) are the JAX package's
formats, so either package reads the other's.
"""

from .admission import (AdmissionController, BucketPricer,  # noqa: F401
                        LEDGER_METRIC, bucket_label)
from .fairness import (DEFAULT_WEIGHTS, FairnessPolicy,  # noqa: F401
                       WidthPolicy)
from .intake import (Intake, PRIORITIES, ServeJob,  # noqa: F401
                     job_from_doc, validate_job)
from .packer import SlotPlan, pack_serve_slot  # noqa: F401
from .queue import ServeQueue, pick_serve_slot  # noqa: F401
from .scheduler import ServeScheduler  # noqa: F401
from .state import (JOB_STATES, LIVE_STATES, make_state,  # noqa: F401
                    read_state, validate_state, write_state)
