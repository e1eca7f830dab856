"""The caching allocator's peak of reserved memory over the window
(``torch.cuda.max_memory_reserved`` after a reset at the window's start), in
GiB: every block it holds, the CUDA graphs' private pools among them, which
``max_memory_allocated`` (``peak_mem_gib.sample``) does not count."""


def read(facts, run):
    b = facts.get("reserved_mem_window")
    return b / 2 ** 30 if b else None
