"""Per-rank heartbeat files and the straggler check (a copy of
`tpukit/obs/heartbeat.py`).

Every rank writes `heartbeat-p{rank:05d}.json` (step, wall time, and the
rollback timeline) to a directory shared by the world, once a window;
rank 0 reads them back and names the ranks whose beat is stale or whose
step lags. The check is advisory: it prints, it kills nothing. Writes are
atomic, so a reader never sees a torn file. `check_divergence` compares
the state checksums beats carry under `--divergence_check_freq`
(`checksum`, `checksum_step`; `obs/divergence.py`). The port has one
process per card, so a "process" here is a c10d rank.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from tpukit_torch import mesh as mesh_lib
from tpukit_torch.checkpoint import atomic_write_text


def _beat_path(directory: Path, process_index: int) -> Path:
    return directory / f"heartbeat-p{process_index:05d}.json"


class Heartbeat:
    """One rank's beat writer and (on any rank) the world's reader."""

    def __init__(self, directory: str | os.PathLike, process_index: int | None = None,
                 process_count: int | None = None, timeout_s: float = 120.0):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.process_index = mesh_lib.rank() if process_index is None else process_index
        self.process_count = mesh_lib.world_size() if process_count is None else process_count
        self.timeout_s = timeout_s
        self.path = _beat_path(self.directory, self.process_index)
        self._last_beat: float | None = None
        self._cadence: float | None = None  # observed seconds between beats

    def beat(self, step: int, now: float | None = None, checksum: str | None = None,
             checksum_step: int | None = None, timeline: int = 0) -> None:
        """Write this rank's record (atomic replace). `timeline` counts the
        rollbacks this rank has executed: checksums are compared only
        within one timeline, since step numbers repeat after a rollback."""
        now = time.time() if now is None else now
        if self._last_beat is not None:
            self._cadence = now - self._last_beat
        self._last_beat = now
        rec = {"process": self.process_index, "step": int(step), "time": now}
        if timeline:
            rec["timeline"] = int(timeline)
        if checksum is not None:
            rec["checksum"] = checksum
            rec["checksum_step"] = int(checksum_step if checksum_step is not None else step)
        atomic_write_text(self.path, json.dumps(rec))

    def read_all(self) -> dict[int, dict]:
        """Every readable beat in the directory, by rank."""
        out: dict[int, dict] = {}
        for path in sorted(self.directory.glob("heartbeat-p*.json")):
            try:
                rec = json.loads(path.read_text())
                out[int(rec["process"])] = rec
            except (ValueError, KeyError, OSError):
                continue  # torn or foreign file: skipped
        return out

    def await_window(self, step: int, timeline: int = 0) -> bool:
        """Wait until every rank's beat is this window's or later (`step`
        on `timeline`, or a later timeline), or the heartbeat timeout has
        passed; whether they all arrived. The ranks of a step run in
        lockstep, so each writes its beat of the window within moments:
        rank 0 compares the checksums of one window, not whichever beats the
        host's load let land before its read. A rank that never beats costs
        one timeout, and the check then reads what is there."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            beats = self.read_all()
            if all(proc in beats and (int(beats[proc].get("timeline", 0)), beats[proc]["step"])
                   >= (timeline, step) for proc in range(self.process_count)):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def check(self, now: float | None = None, step_lag: int = 0) -> list[dict]:
        """The stragglers: ranks whose beat is missing, older than the
        effective timeout (`max(timeout_s, 3 x this rank's own beat
        cadence)`), or (`step_lag` > 0) more than `step_lag` steps behind
        the world's furthest. One `{process, reason, ...}` record each."""
        now = time.time() if now is None else now
        effective = self.timeout_s
        if self._cadence:
            effective = max(effective, 3.0 * self._cadence)
        beats = self.read_all()
        max_step = max((r.get("step", 0) for r in beats.values()
                        if self.process_count == 1
                        or int(r.get("process", -1)) < self.process_count), default=0)
        out = []
        for proc in range(self.process_count):
            rec = beats.get(proc)
            if rec is None:
                out.append({"process": proc, "reason": "missing"})
                continue
            age = now - rec.get("time", 0.0)
            if age > effective:
                out.append({"process": proc, "reason": "stale", "age_s": round(age, 1),
                            "step": rec.get("step")})
            elif step_lag and max_step - rec.get("step", 0) > step_lag:
                out.append({"process": proc, "reason": "lagging", "step": rec.get("step"),
                            "behind": max_step - rec.get("step", 0)})
        return out

    def check_divergence(self) -> list[dict]:
        """Checksums compared across ranks at the same (timeline,
        checksum_step); the minority ranks at any point with more than one
        checksum are reported against the majority's (ties broken by the
        checksum string): `{process, checksum_step, checksum, expected}`."""
        by_key: dict[tuple[int, int], dict[str, list[int]]] = {}
        for rec in self.read_all().values():
            if self.process_count > 1 and int(rec.get("process", -1)) >= self.process_count:
                continue  # a beat of a larger earlier world
            cs, st = rec.get("checksum"), rec.get("checksum_step")
            if cs is None or st is None:
                continue
            key = (int(rec.get("timeline", 0)), int(st))
            by_key.setdefault(key, {}).setdefault(str(cs), []).append(int(rec["process"]))
        out = []
        for key in sorted(by_key):
            groups = by_key[key]
            if len(groups) < 2:
                continue
            ranked = sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0]))
            majority = ranked[0][0]
            for cs, procs in ranked[1:]:
                for proc in sorted(procs):
                    out.append({"process": proc, "checksum_step": key[1], "checksum": cs,
                                "expected": majority})
        return out
