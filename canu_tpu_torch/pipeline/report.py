"""Persistent key-value assembly report (Report.pm equivalent).

The port's own copy of canu_tpu.pipeline.report.

The reference accumulates per-stage report text in `$asm.report`
(Canu src/pipelines/canu/Report.pm:54-169, addToReport /
getFromReport); same contract here, JSON-backed.
"""

from __future__ import annotations

import json
import os
from typing import Optional


class Report:
    def __init__(self, path: str):
        self.path = path
        self.data: dict[str, str] = {}
        if os.path.exists(path):
            with open(path) as fh:
                self.data = json.load(fh)

    def add(self, key: str, text: str) -> None:
        self.data[key] = text
        tmp = self.path + ".WORKING"
        with open(tmp, "w") as fh:
            json.dump(self.data, fh, indent=1)
        os.replace(tmp, self.path)

    def get(self, key: str) -> Optional[str]:
        return self.data.get(key)

    def render(self) -> str:
        return "\n".join(f"[{k}]\n{v}\n" for k, v in self.data.items())
