"""The share of the chunked count's dumped bytes that went to the host
through the staged readback: 100 x the sum of
``stats["dump_staged_bytes"]`` (the bytes the dumps moved through the
staging pair) over 12 x the sum of ``stats["dumped"]`` (a dumped record
is an 8-B key and a 4-B count), over the counts that report the staged
bytes: 100 where every dump was read back staged. None where no count
reports them (a program without the staged readback) or none dumped."""


def read(obs):
    stats = [s for s in obs.get("count_stats") or []
             if "dump_staged_bytes" in s]
    dumped = sum(s["dumped"] for s in stats)
    if not dumped:
        return None
    return 100 * sum(s["dump_staged_bytes"] for s in stats) / (12 * dumped)
