"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), in GiB."""

from port_bench.readers import peak_gib


def read(facts, run):
    return peak_gib(facts)
