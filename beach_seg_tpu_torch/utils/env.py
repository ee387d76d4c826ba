"""Environment knobs (counterpart of ``beach_seg_tpu/utils/env.py``'s
``env_flag``, kept as its own copy: the port imports nothing of the JAX
package)."""

from __future__ import annotations

import os


def env_flag(name: str) -> bool:
    """Parse a boolean env knob: unset or "0" is off, anything else is on.

    Single source of truth for the BEACH_SEG_TPU_* feature flags so sites
    that must agree cannot drift apart in how they parse the value.
    """
    return os.environ.get(name, "") not in ("", "0")
