"""Line-by-line JSONL iteration (parity with reference ``utils/jsonl.py``):
malformed lines are warned about and skipped, not fatal. A copy of
``multimeditron_tpu/utils/jsonl.py``: the port imports nothing of the JAX
package."""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Iterator

logger = logging.getLogger(__name__)


class JSONLGenerator:
    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        with open(self.path) as f:
            for line_no, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError as e:
                    logger.warning(
                        "Skipping malformed JSONL line %d in %s: %s",
                        line_no, self.path, e,
                    )
