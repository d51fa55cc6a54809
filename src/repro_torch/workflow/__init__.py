"""Mini workflow manager with GeStore integration (the paper's GePan)."""
from .manager import Tool, WorkflowManager, WorkflowResult

__all__ = ["Tool", "WorkflowManager", "WorkflowResult"]
