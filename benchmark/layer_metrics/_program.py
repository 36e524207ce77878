"""What the readers of the program's own counters share.

The program counts, always on, each call of a layer's root span
(``<root>.calls``) and each point where its host waits on the card
(``host_sync.<layer>.<site>``) in ``ganmf_tpu_torch.utils.profiling``. A
reader runs in the process that ran the cell, once the run is over, so it
reads the counts of the whole run: set-up, window and traced units. Every
unit of a cell takes the same path, so their ratio is the count of one
unit. A program without those counters gives None.
"""


def host_syncs_per_call(root: str):
    """The host syncs of the root's layer (the sites ``host_sync.<layer>.*``
    of the root ``<layer>.<name>``) over the root's calls in the run."""
    from ganmf_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    counts = read()
    calls = counts.get(f"{root}.calls", 0)
    if not calls:
        return None
    sites = f"host_sync.{root.split('.')[0]}."
    return sum(v for k, v in counts.items() if k.startswith(sites)) / calls
