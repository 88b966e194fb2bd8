"""Hybrid collaboration pattern (paper §2): combine >= 2 ECCI patterns.

The ShadowTutor shape: the CC runs a heavy *teacher* for inference AND
trains a lightweight *student* online (ECC inference + ECC training); edges
run student inference and periodically fetch refreshed student weights via
the file service. The video query application itself is a hybrid instance
(COC labels training data for EOC, which is trained on the CC and deployed
to edges — paper §5.1.2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

from repro_torch.core.registry import image


@image("repro/pattern/teacher")
class TeacherComponent:
    """CC: heavy inference + online student training on hard items."""

    def __init__(self, teacher_infer: Callable = None,
                 train_student: Callable = None, student_params=None,
                 refresh_every: int = 8, student_bytes: int = 500_000):
        self.teacher_infer = teacher_infer
        self.train_student = train_student
        self.student_params = student_params
        self.refresh_every = refresh_every
        self.student_bytes = student_bytes
        self.buffer: List = []
        self.version = 0

    def start(self, ctx) -> None:
        self.ctx = ctx
        ctx.subscribe("hybrid/hard", self._on_hard)
        self._publish_student()

    def _on_hard(self, msg) -> None:
        item = msg.payload
        label = self.teacher_infer(item)
        self.ctx.publish("hybrid/teacher-out", {"item": item, "label": label},
                         nbytes=64)
        self.buffer.append((item, label))
        if len(self.buffer) >= self.refresh_every and self.train_student:
            self.student_params = self.train_student(
                self.student_params, self.buffer)
            self.buffer = []
            self.version += 1
            self._publish_student()

    def _publish_student(self) -> None:
        files = self.ctx.services["file"]
        files.put("hybrid", f"student-{self.version}", self.student_params,
                  self.student_bytes, self.ctx.cluster)


@image("repro/pattern/student")
class StudentComponent:
    """Edge: student inference; escalates low-confidence items; hot-swaps
    refreshed student weights announced on the bridged control plane."""

    def __init__(self, student_infer: Callable = None, threshold: float = 0.8):
        self.student_infer = student_infer
        self.threshold = threshold
        self.params = None
        self.results: List = []
        self.escalated = 0

    def start(self, ctx) -> None:
        self.ctx = ctx
        files = ctx.services["file"]
        files.on_available(ctx.cluster, "hybrid/student-*", self._fetch)
        ctx.subscribe("hybrid/in", self._on_item)

    def _fetch(self, meta: dict) -> None:
        files = self.ctx.services["file"]
        files.get(meta["bucket"], meta["key"], self.ctx.cluster,
                  self._swap)

    def _swap(self, params) -> None:
        self.params = params
        self.ctx.log("student_refreshed")

    def _on_item(self, msg) -> None:
        if self.params is None:
            self.ctx.publish("hybrid/hard", msg.payload, nbytes=msg.nbytes)
            self.escalated += 1
            return
        label, conf = self.student_infer(self.params, msg.payload)
        if conf >= self.threshold:
            self.results.append((msg.payload, label))
        else:
            self.escalated += 1
            self.ctx.publish("hybrid/hard", msg.payload, nbytes=msg.nbytes)
