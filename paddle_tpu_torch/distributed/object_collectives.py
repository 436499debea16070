"""Object collectives (counterpart of the reference's
``distributed/object_collectives.py``), over torch's: objects are
pickled into tensors and move through the group's process group (the
reference passes them through its rendezvous store). A local one-rank
group returns its own objects.
"""
from __future__ import annotations

import torch.distributed as dist

from .collective import _active, _resolve

__all__ = ["all_gather_object", "broadcast_object_list",
           "scatter_object_list"]


def all_gather_object(object_list, obj, group=None):
    """Every rank's ``obj`` appended to ``object_list``, in group rank
    order."""
    g = _resolve(group)
    if not _active(g):
        object_list.append(obj)
        return object_list
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.process_group)
    object_list.extend(out)
    return object_list


def broadcast_object_list(object_list, src=0, group=None):
    """``object_list``'s entries replaced, in place, by global rank
    ``src``'s."""
    g = _resolve(group)
    if _active(g):
        dist.broadcast_object_list(object_list, src, group=g.process_group)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Group rank i receives ``in_object_list[i]`` as global rank ``src``
    holds it: ``out_object_list`` becomes ``[that object]``."""
    g = _resolve(group)
    if not _active(g):
        out_object_list[:] = [(in_object_list or [None])[0]]
        return out_object_list
    out = [None]
    dist.scatter_object_list(
        out, in_object_list if dist.get_rank() == src else None, src,
        group=g.process_group)
    out_object_list[:] = out
    return out_object_list
