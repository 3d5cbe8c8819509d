"""The one traffic generator. A traffic mix is a JSON file of parameters in
``vbench/traffic/``; this module reads it and drives a server with it.

Parameters of a mix:

- ``loop``: ``"closed"`` (``clients`` threads, each sends its next request
  when its last answer came back) or ``"open"`` (arrivals on a schedule at
  ``rate_per_s``, whatever the server does).
- ``extents``: ``[[width, height, share], ...]``, the requests' sizes.
- ``pool``: distinct images made for each extent at set-up.
- ``lead_s``: seconds of the same traffic before the measured window opens.
- ``check_per_extent``: answers of each extent kept, drawn from the seed,
  for the comparison with the reference.
- ``late_wait_s``: how long past the window's close the open loop waits for
  answers due in the window (a request still unanswered then is failed).

The open loop's arrivals are a Poisson process whose gaps are the quantiles
of the exponential distribution, in an order drawn from the seed: every seed
gets the same number of requests of each extent and the same set of gaps in
another order, so seeds change the order of the work and not the work.
Latency runs from a request's due time, so a late sender or a stall shows
in every request behind it.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["Traffic", "Record", "load_traffic", "run_closed", "run_open", "open_schedule"]


@dataclass
class Traffic:
    loop: str
    extents: list
    pool: int = 32
    clients: int = 0
    rate_per_s: float = 0.0
    lead_s: float = 2.0
    check_per_extent: int = 4
    late_wait_s: float = 60.0

    def __post_init__(self):
        if self.loop not in ("closed", "open"):
            raise ValueError(f"traffic loop must be closed or open, got {self.loop!r}")
        if self.loop == "closed" and self.clients < 1:
            raise ValueError("a closed loop needs clients >= 1")
        if self.loop == "open" and self.rate_per_s <= 0:
            raise ValueError("an open loop needs rate_per_s > 0")
        shares = [e[2] for e in self.extents]
        if not self.extents or min(shares) <= 0 or abs(sum(shares) - 1.0) > 1e-6:
            raise ValueError(f"extent shares must be positive and sum to 1, got {shares}")


def load_traffic(path: Path, overrides: dict | None = None) -> Traffic:
    params = json.loads(Path(path).read_text())
    params.update(overrides or {})
    params.pop("why", None)
    return Traffic(**params)


@dataclass
class Record:
    """What the load saw: one row per request sent, the answers kept for
    the check, and how late the open loop's sender ran."""

    t_open: float = 0.0
    t_close: float = 0.0
    rows: list = field(default_factory=list)  # (extent index, pool index, due, sent, done or None, ok)
    kept: list = field(default_factory=list)  # (extent index, pool index, answer)
    lateness_s: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    t_gave_up: float = 0.0  # when the open loop stopped waiting for answers
    lock: threading.Lock = field(default_factory=threading.Lock)

    def window_rows(self):
        """Requests due (open) or sent (closed) inside the window."""
        return [r for r in self.rows if self.t_open <= r[2] < self.t_close]

    def completed_in_window(self):
        return [r for r in self.rows if r[5] and r[4] is not None and self.t_open <= r[4] <= self.t_close]


def _counts(extents, n: int) -> list[int]:
    """n requests split by the shares, the rounding remainder to the first."""
    c = [int(math.floor(e[2] * n)) for e in extents]
    c[0] += n - sum(c)
    return c


def open_schedule(traffic: Traffic, seconds: float, rng: np.random.Generator):
    """[(due offset s from the start of the lead-in, extent index, pool
    index)]: the lead-in's arrivals, then the window's, which starts at
    ``traffic.lead_s``."""
    out = []
    t0 = 0.0
    for span in (traffic.lead_s, seconds):
        n = max(1, int(round(traffic.rate_per_s * span)))
        q = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-q) / traffic.rate_per_s
        gaps *= span / gaps.sum()
        gaps = rng.permutation(gaps)
        due = t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        kinds = rng.permutation(np.repeat(np.arange(len(traffic.extents)), _counts(traffic.extents, n)))
        nxt = [0] * len(traffic.extents)
        perms = [rng.permutation(traffic.pool) for _ in traffic.extents]
        for t, k in zip(due, kinds):
            out.append((float(t), int(k), int(perms[k][nxt[k] % traffic.pool])))
            nxt[k] += 1
        t0 += span
    return out


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05) if left > 0.002 else left)


def run_closed(submit, requests, traffic: Traffic, seconds: float, rng: np.random.Generator, record: Record,
               result_pixels) -> None:
    """``traffic.clients`` threads, each sending its next request when its
    last answer came back, from the start of the lead-in (``traffic.lead_s``
    before ``record.t_open``) until the window closes at ``record.t_close``;
    then every answer outstanding is awaited. ``requests[k][i]`` is
    pool image i of extent k as a request. Answers completed inside the
    window are sampled per extent by reservoir, drawn from ``rng``."""
    n_ext = len(traffic.extents)
    picks = [rng.integers(0, 2**63) for _ in range(traffic.clients)]
    reservoir = [[] for _ in range(n_ext)]
    seen = [0] * n_ext
    sample_rng = np.random.default_rng(rng.integers(0, 2**63))
    _sleep_until(record.t_open - traffic.lead_s)
    errors = []

    def client(c: int):
        crng = np.random.default_rng(picks[c])
        shares = np.array([e[2] for e in traffic.extents])
        try:
            while True:
                sent = time.perf_counter()
                if sent >= record.t_close:
                    return
                k = int(crng.choice(n_ext, p=shares)) if n_ext > 1 else 0
                i = int(crng.integers(traffic.pool))
                try:
                    answer = submit(requests[k][i]).result()
                    ok = True
                except Exception as e:  # noqa: BLE001 — a failed request counts as failed, the load goes on
                    answer, ok = None, False
                    errors.append(repr(e))
                done = time.perf_counter()
                with record.lock:
                    record.rows.append((k, i, sent, sent, done, ok))
                    if ok and record.t_open <= done <= record.t_close:
                        seen[k] += 1
                        slot = len(reservoir[k]) if len(reservoir[k]) < traffic.check_per_extent else \
                            int(sample_rng.integers(seen[k]))
                        if slot < traffic.check_per_extent:
                            item = (k, i, np.array(result_pixels(answer), copy=True))
                            if slot == len(reservoir[k]):
                                reservoir[k].append(item)
                            else:
                                reservoir[k][slot] = item
        except Exception as e:  # noqa: BLE001 — reported with the run's errors
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(traffic.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + traffic.lead_s + traffic.late_wait_s + 60)
    record.kept = [item for r in reservoir for item in r]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("closed loop: a client did not finish")
    record.errors = errors


def run_open(submit, requests, traffic: Traffic, seconds: float, rng: np.random.Generator, record: Record,
             result_pixels) -> None:
    """One sender thread submits each request at its due time (the schedule
    of :func:`open_schedule`, from ``traffic.lead_s`` before
    ``record.t_open``); answers are timed as they arrive. After the
    window closes, answers due in it are awaited up to
    ``traffic.late_wait_s``; one that has not come then is failed. The
    answers kept for the check are drawn from ``rng`` in advance among the
    requests due in the window, ``check_per_extent`` of each extent."""
    schedule = open_schedule(traffic, seconds, rng)
    start = record.t_open - traffic.lead_s
    in_window = [j for j, (t, _, _) in enumerate(schedule) if t >= traffic.lead_s]
    keep = set()
    for k in range(len(traffic.extents)):
        of_k = [j for j in in_window if schedule[j][1] == k]
        n = min(traffic.check_per_extent, len(of_k))
        if n:
            keep.update(int(j) for j in rng.choice(of_k, size=n, replace=False))
    rows = [None] * len(schedule)
    pending = [len(schedule)]
    done_event = threading.Event()
    errors = []

    def settle(j, row):
        """Called under the record's lock."""
        rows[j] = row
        pending[0] -= 1
        if not pending[0]:
            done_event.set()

    def finish(j, due, sent, fut):
        t = time.perf_counter()
        k, i = schedule[j][1], schedule[j][2]
        try:
            answer = fut.result()
            ok = True
        except Exception as e:  # noqa: BLE001 — a failed request counts as failed
            answer, ok = None, False
            errors.append(repr(e))
        with record.lock:
            if ok and j in keep:
                record.kept.append((k, i, np.array(result_pixels(answer), copy=True)))
            settle(j, (k, i, due, sent, t, ok))

    for j, (offset, k, i) in enumerate(schedule):
        due = start + offset
        _sleep_until(due)
        sent = time.perf_counter()
        record.lateness_s.append(sent - due)
        try:
            fut = submit(requests[k][i])
        except Exception as e:  # noqa: BLE001 — a refused request counts as failed
            with record.lock:
                settle(j, (k, i, due, sent, None, False))
            errors.append(repr(e))
            continue
        fut.add_done_callback(lambda f, j=j, due=due, sent=sent: finish(j, due, sent, f))
    done_event.wait(timeout=max(0.0, record.t_close + traffic.late_wait_s - time.perf_counter()))
    with record.lock:
        record.t_gave_up = time.perf_counter()
        for j, (offset, k, i) in enumerate(schedule):
            if rows[j] is None:  # never answered: failed, its latency the wait so far
                rows[j] = (k, i, start + offset, start + offset, None, False)
        record.rows = rows
    record.errors = errors
