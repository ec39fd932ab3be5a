"""Task scheduler — ``misc_modules/scheduler`` capability (PyTorch
counterpart of ``sdrtpu/apps/scheduler.py``; host code).

Time-based automation: at scheduled times run actions (tune, start/stop
recording, arbitrary callables).  Deterministic: `tick(now)` is driven by
the host loop (or a thread via `run_background`).
"""

from __future__ import annotations

import datetime
import logging
import threading
from dataclasses import dataclass
from typing import Callable

log = logging.getLogger(__name__)


@dataclass
class Task:
    at: datetime.datetime
    action: Callable[[], None]
    name: str = ""
    recurring_days: int = 0  # 0 = one-shot; N = repeat every N days
    done: bool = False


class Scheduler:
    def __init__(self):
        self.tasks: list[Task] = []
        self._lock = threading.Lock()
        self._thread = None
        self._running = False

    def add(self, task: Task) -> None:
        with self._lock:
            self.tasks.append(task)

    def tick(self, now: datetime.datetime | None = None) -> int:
        """Run all due tasks; returns how many fired.

        Actions run OUTSIDE the lock (an action may call ``add()`` to
        reschedule itself without deadlocking) and a raising action is
        logged, never allowed to kill the scheduler thread or starve the
        other due tasks.
        """
        now = now or datetime.datetime.now()
        due: list[Task] = []
        with self._lock:
            for t in self.tasks:
                if t.done or t.at > now:
                    continue
                due.append(t)
                if t.recurring_days:
                    t.at += datetime.timedelta(days=t.recurring_days)
                else:
                    t.done = True
            self.tasks = [t for t in self.tasks if not t.done]
        for t in due:
            try:
                t.action()
            except Exception:
                log.exception("scheduled task %r failed", t.name)
        return len(due)

    def run_background(self, interval: float = 1.0) -> None:
        self._running = True

        def loop():
            import time

            while self._running:
                self.tick()
                time.sleep(interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
