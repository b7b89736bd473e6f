"""Named consecutive ranges of the train step for ``torch.profiler``.

``spans("render.traverse")`` closes the previous range and opens the next;
``spans.close()`` ends the last. Each range is a
``torch.profiler.record_function``: with no profiler running it costs a
few microseconds of host time and records nothing. chip_smoke.py's
``profile`` phase reads them as the step's per-layer host and device time.
"""

from __future__ import annotations

import torch


class Spans:
    def __init__(self):
        self._cur = None

    def __call__(self, name: str) -> None:
        self.close()
        self._cur = torch.profiler.record_function(name)
        self._cur.__enter__()

    def close(self) -> None:
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self._cur = None
