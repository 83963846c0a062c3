"""The ``eval`` kind (``kinds/eval.py``: the same passes, rate and check),
whose traced pass also gives the per-layer readers what ``run.Layers``
does not hold: the device time under each of the program's model spans
(``lib/devspans.py``, read from the raw trace before the run removes it)
and the cell's configuration and frame size, from which
``lib/attention.py`` counts the attention products."""

import os

from benchmark.kinds import eval as base
from benchmark.lib.devspans import device_us_under

# the program's spans inside a model step, copied here so that the
# program may change and the yardstick not
MODEL_SPANS = ("evreal.etnet.encode", "evreal.etnet.transformer",
               "evreal.etnet.decode")


class Run(base.Run):
    def __init__(self, run):
        super().__init__(run)
        self.span_device_us = {}

    def window(self, seconds, traced=None):
        out = super().window(seconds, traced)
        if traced is not None:
            # run.py's profiled() has written the traced pass here
            self.span_device_us = device_us_under(
                os.path.join(self.r.workdir, "trace.json"), MODEL_SPANS)
        return out

    def layer_counts(self):
        return dict(super().layer_counts(), config=self.config,
                    height=self.h, width=self.w,
                    span_device_us=self.span_device_us)
