"""Jupyter progress bars via ipywidgets.

Carried over from :mod:`heracles_tpu.notebook`, which imports no jax.

Gated on ipywidgets being importable; implements the Progress protocol
as a VBox of IntProgress bars, one per (nested) task.
"""

from __future__ import annotations

from .core import external_dependency_explainer

with external_dependency_explainer:
    import ipywidgets
    from IPython.display import display

__all__ = ["NotebookProgress"]


class NotebookProgress:
    """Progress implementation rendering ipywidgets progress bars."""

    def __init__(self, label="progress", *, parent=None, container=None):
        self.label = label
        self.parent = parent
        if container is None:
            container = ipywidgets.VBox()
        self.container = container
        self._bar = None

    def _ensure_bar(self):
        if self._bar is None:
            self._bar = ipywidgets.IntProgress(
                value=0, min=0, max=1, description=str(self.label)
            )
            self.container.children = (*self.container.children, self._bar)
        return self._bar

    def update(self, current=None, total=None):
        bar = self._ensure_bar()
        if total is not None:
            bar.max = total
        if current is not None:
            bar.value = current

    def task(self, label):
        return NotebookProgress(label, parent=self, container=self.container)

    def __enter__(self):
        self._ensure_bar()
        if self.parent is None:
            display(self.container)
        return self

    def __exit__(self, *exc):
        if self._bar is not None:
            children = list(self.container.children)
            if self._bar in children:
                children.remove(self._bar)
                self.container.children = tuple(children)
        return None
