"""The share of the FASTQ text read that the card parsed (P1): 100 x the
sum of ``stats["card_parsed_bytes"]`` (the bytes P1 received, each block
once) over the sum of ``stats["input_bytes"]`` (the bytes read), over
the counts of the window that report them: 100 where every byte read
was parsed on the card (a newline the program adds to a file without a
final one counts too). None where no count reports them: a program that
parses on the host."""


def read(obs):
    stats = [s for s in obs.get("count_stats") or [] if "input_bytes" in s]
    read_bytes = sum(s["input_bytes"] for s in stats)
    if not read_bytes:
        return None
    return 100 * sum(s.get("card_parsed_bytes", 0) for s in stats) \
        / read_bytes
