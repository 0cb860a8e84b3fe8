"""Terminal progress bars via rich.

Carried over from :mod:`heracles_tpu.rich_progress`, which imports no jax.

Implements the :class:`~heracles_tpu_torch.progress.Progress` protocol with a
depth-sorted task table so nested tasks (catalogue -> field -> pages)
render in a stable order.
"""

from __future__ import annotations

from .core import external_dependency_explainer

with external_dependency_explainer:
    import rich.progress

__all__ = ["RichProgress"]


class RichProgress:
    """Progress implementation on top of rich.progress.Progress."""

    def __init__(self, label="progress", *, parent=None, box=None):
        self.label = label
        self.parent = parent
        if box is None:
            box = rich.progress.Progress(
                rich.progress.TextColumn("{task.description}"),
                rich.progress.BarColumn(),
                rich.progress.TaskProgressColumn(),
                rich.progress.TimeElapsedColumn(),
                transient=False,
            )
        self.box = box
        self._depth = 0 if parent is None else parent._depth + 1
        self._task_id = None

    def _ensure_task(self):
        if self._task_id is None:
            self._task_id = self.box.add_task(
                "  " * self._depth + str(self.label), total=None
            )
        return self._task_id

    def update(self, current=None, total=None):
        task_id = self._ensure_task()
        self.box.update(task_id, completed=current, total=total)

    def task(self, label):
        return RichProgress(label, parent=self, box=self.box)

    def __enter__(self):
        self._ensure_task()
        if self.parent is None:
            self.box.start()
        return self

    def __exit__(self, *exc):
        if self._task_id is not None:
            try:
                self.box.update(self._task_id, visible=False)
            except KeyError:
                pass
        if self.parent is None:
            self.box.stop()
        return None
