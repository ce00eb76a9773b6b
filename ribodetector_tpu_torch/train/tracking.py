"""Metric tracking utilities.

Counterpart of the reference's vestigial utils (SURVEY.md C15:
ribodetector/utils/util.py MetricTracker/inf_loop and read_json/write_json),
without the pandas dependency.
"""

import json
from collections import OrderedDict
from pathlib import Path


class MetricTracker:
    """Running averages per metric key (utils/util.py:22-49 equivalent)."""

    def __init__(self, *keys):
        self._data = {k: [0.0, 0] for k in keys}  # total, count

    def reset(self):
        for v in self._data.values():
            v[0], v[1] = 0.0, 0

    def update(self, key, value, n=1):
        if key not in self._data:
            self._data[key] = [0.0, 0]
        self._data[key][0] += float(value) * n
        self._data[key][1] += n

    def avg(self, key):
        total, count = self._data[key]
        return total / count if count else 0.0

    def result(self):
        return {k: self.avg(k) for k in self._data}


def inf_loop(data_loader):
    """Endlessly repeat an iterable (utils/util.py:16-19 equivalent)."""
    while True:
        yield from data_loader


def read_json(fname):
    with Path(fname).open("rt") as handle:
        return json.load(handle, object_hook=OrderedDict)


def write_json(content, fname):
    with Path(fname).open("wt") as handle:
        json.dump(content, handle, indent=4, sort_keys=False)
