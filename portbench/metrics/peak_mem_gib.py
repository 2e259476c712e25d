"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and the
window (reset when the run starts), in GiB."""


def read(record):
    if not record.get("on_card"):
        return None
    return record["peak_bytes"] / 2**30 if record["peak_bytes"] else None
