"""Small shared helpers (the port of drsa_audio_tpu.utils.utilities;
reference cxai/utils/utilities.py). ``round_down`` lives with the
front-end that uses it and is re-exported here."""

from __future__ import annotations

import contextlib
import io
import sys

from drsa_audio_tpu_torch.ops.frontend import round_down

__all__ = ["HiddenPrints", "round_down"]


class HiddenPrints(contextlib.ContextDecorator):
    """Silence stdout inside the block (utilities.py:19-26)."""

    def __enter__(self):
        self._stdout = sys.stdout
        sys.stdout = io.StringIO()
        return self

    def __exit__(self, *exc):
        sys.stdout = self._stdout
        return False
