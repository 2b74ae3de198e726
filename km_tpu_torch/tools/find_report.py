"""find_report: reshape find_mutation rows into genome-coordinate
reports (16-column TSV, VCF 4.1, or per-sample pivot table).

Behavior contract (byte-compatible with km; reference:
km/tools/find_report.py:7-336, checked by tests/test_golden_files.py):
coordinates map through the per-base genomic position list derived from
the target FASTA exon headers (strand-aware); insertions/deletions are
canonicalized by sliding through repeated context to their outermost
placement; small insertions re-classify as ITD (exact upstream
duplicate >= 3 bp) or I&I (> 50% upstream match).
"""

from __future__ import annotations

import re
import sys

from ..io.fasta import iter_fasta, parse_header_attrs
from .find_mutation import load_table

_REPORT_COLUMNS = [
    "Sample", "Region", "Location", "Type", "Removed", "Added", "Abnormal",
    "Normal", "rVAF", "Min_coverage", "Exclu_min_cov", "Variant", "Target",
    "Info", "Variant_sequence", "Reference_sequence",
]

_COMPLEMENT = str.maketrans("ATGCU", "TACGA")


def _emit(fields):
    sys.stdout.write("\t".join(fields) + "\n")


def _vcf_header():
    sys.stdout.write(
        "##fileformat=VCFv4.1\n"
        "##INFO=<ID=TYPE,Number=A,Type=String,Description="
        '"The type of variant, either Insertion, ITD, I&I, Deletion, '
        'Substitution or Indel.">\n'
        "##INFO=<ID=TARGET,Number=A,Type=String,Description="
        '"Name of the sequencing that contains the mutation.">\n'
        '##INFO=<ID=RATIO,Number=A,Type=String,Description="Ratio of '
        'mutation to reference.">\n'
        "##INFO=<ID=MINCOV,Number=A,Type=String,Description="
        '"Minimum k-mer coverage of alternative allele.">\n'
        '##INFO=<ID=REMOVED,Number=A,Type=String,Description="Number of '
        'removed bases.">\n'
        '##INFO=<ID=ADDED,Number=A,Type=String,Description="Number of '
        'added bases.">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    )


class GenomeMap:
    """Target-index -> genome-coordinate mapping from the FASTA exon
    headers. Index i of the concatenated target maps to ``nts[i]``
    (1-based genomic); '-'-strand exons contribute their positions in
    reverse so the mapping is monotone within an exon either way."""

    def __init__(self, target_path):
        if not target_path:
            sys.exit("ERROR: Target file is empty\n")
        self.nts: list[int] = []
        self.chro = None
        self.strand = None
        for header, _seq in iter_fasta(target_path):
            loc_token = header.split(" ")[0]
            if ":" not in loc_token or "-" not in loc_token:
                sys.exit("ERROR: Fasta entries do not contain a correctly "
                         "formatted location: {}\n".format(loc_token))
            attr = parse_header_attrs(header)
            self.chro, pos = attr["location"].split(":")
            lo, hi = pos.split("-")
            if "strand" not in attr:
                attr["strand"] = "+"
                sys.stderr.write("WARNING: Strand is assumed to be '+' \n")
            self.strand = attr["strand"]
            exon = list(range(int(lo), int(hi) + 1))
            self.nts.extend(reversed(exon) if self.strand == "-"
                            else exon)

    @property
    def minus(self) -> bool:
        return self.strand == "-"

    def whole_region(self) -> str:
        lo, hi = ((self.nts[-1], self.nts[0]) if self.minus
                  else (self.nts[0], self.nts[-1]))
        return "{}:{}-{}".format(self.chro, lo, hi)

    def span(self, i: int, j: int) -> tuple[int, int]:
        """Genomic (low, high) anchors of target window [i, j]."""
        if self.minus:
            return self.nts[j], self.nts[i]
        return self.nts[i], self.nts[j]

    def region(self, i: int, j: int) -> str:
        lo, hi = self.span(i, j)
        return "{}:{}-{}".format(self.chro, lo, hi + 1)

    def allele_anchors(self, ib: int, ia: int,
                       length: int) -> tuple[int, int]:
        """Genomic (first, last) coordinates of a ``length``-base allele
        whose outermost target indices are ib (left) / ia (right)."""
        if self.minus:
            return self.nts[ia], self.nts[ia - length + 1]
        return self.nts[ib], self.nts[ib + length - 1]


def _slide_left(var: str, p: int, seq: str) -> int:
    """Leftmost placement of ``var`` sliding through repeated context:
    returns the index just left of the final position (reference models
    this as recursion, km/tools/find_report.py:84-88)."""
    while p - 1 > 0 and seq[p - 1] == var[-1]:
        var = seq[p - 1] + var[:-1]
        p -= 1
    return p - 1


def _repeat_flanks(ref_seq: str, var: str, left: int, right: int):
    """Slide ``var`` outward through repeats on both sides: ``left`` is
    the target index where the variant window starts, ``right`` where
    the reference resumes after it. Returns (before, after, ib, ia) with
    before = ref_seq[ib:left] and ``after`` ending at index ia."""
    ib = _slide_left(var, left, ref_seq)
    rev = ref_seq[::-1]
    rpos = len(ref_seq) - right
    ja = _slide_left(var[::-1], rpos, rev)
    after = rev[ja:rpos][::-1]
    return ref_seq[ib:left], after, ib, len(ref_seq) - ja - 1


def _dup_classify(insert: str, alt_seq: str, pos: int) -> str:
    """Insertion subtype against its upstream context: 'ITD' for an
    exact >= 3 bp duplication, 'I&I' when over half the bases match."""
    if pos - len(insert) < 0 or len(insert) < 3:
        return "Insertion"
    upstream = alt_seq[pos - len(insert):pos]
    if insert == upstream:
        return "ITD"
    matched = sum(a == b for a, b in zip(insert, upstream))
    return "I&I" if matched / len(insert) > 0.5 else "Insertion"


class _Row:
    """Parsed columns of one find_mutation line."""

    def __init__(self, tok):
        self.samp = tok[0]
        self.query = tok[1]
        self.type_ = tok[2]
        self.pos_str = tok[3]
        self.ratio = tok[4]
        self.alt_exp = tok[5]
        self.min_cov = tok[6]
        self.start_off = tok[7]
        self.alt_seq = tok[8]
        self.ref_exp = tok[9]
        self.ref_seq_raw = tok[10]
        self.info = tok[11]


class _Variant:
    """Resolved genome-space description of one mutation row, ready for
    any output mode."""

    def __init__(self, region, location, type_, removed, added,
                 variant, ref_allele, alt_allele, loc, end):
        self.region = region
        self.location = location
        self.type_ = type_
        self.removed = removed
        self.added = added
        self.variant = variant
        self.ref_allele = ref_allele
        self.alt_allele = alt_allele
        self.loc = loc
        self.end = end

    @property
    def split_across_exons(self) -> bool:
        """True when the allele's genomic span is not contiguous (the
        variant crosses an exon boundary) — VCF rows are disabled."""
        return self.loc + len(self.ref_allele) - 1 != self.end


def _resolve_insertion(row, gm, pos, end, delet, insert, ref_seq, mod):
    region = gm.region(pos, end + 1)
    var = insert.upper()
    before, after, ib, ia = _repeat_flanks(ref_seq, var, pos, pos)
    ref_allele = before + after
    loc, vend = gm.allele_anchors(ib, ia, len(ref_allele))
    span_lo, span_hi = gm.span(pos, end + 1)
    type_ = _dup_classify(insert, row.alt_seq, pos)
    added = str(len(insert))
    if type_ != "Insertion":
        added += " | " + str(span_hi - span_lo + 1)
    return _Variant(region, gm.chro + ":" + str(span_hi), type_,
                    str(len(delet)), added, mod, ref_allele,
                    before + var + after, loc, vend)


def _resolve_deletion(row, gm, pos, end, delet, insert, ref_seq, mod):
    var = delet.upper()
    before, after, ib, ia = _repeat_flanks(ref_seq, var, pos,
                                           pos + len(var))
    ref_allele = before + var + after
    loc, vend = gm.allele_anchors(ib, ia, len(ref_allele))
    return _Variant(gm.region(pos, end), "", row.type_, str(len(delet)),
                    str(len(insert)), mod, ref_allele, before + after,
                    loc, vend)


def _resolve_substitution(row, gm, pos, end, delet, insert, ref_seq, mod):
    lo, hi = gm.span(pos, end)
    return _Variant(gm.region(pos, end), gm.chro + ":" + str(lo),
                    row.type_, str(len(delet)), str(len(insert)), mod,
                    delet.upper(), insert.upper(), lo, hi)


def _resolve_indel(row, gm, pos, end, delet, insert, ref_seq, mod):
    lo, hi = gm.span(pos, end)
    left, right = ref_seq[pos - 1], ref_seq[end + 1]
    return _Variant(gm.region(pos, end), gm.chro + ":" + str(hi),
                    row.type_, str(len(delet)), str(len(insert)), mod,
                    left + delet.upper() + right,
                    left + insert.upper() + right, lo - 1, hi + 1)


def _resolve(row, gm):
    """Mutation row -> _Variant (genome space), or None to drop it."""
    start, mod, stop = row.pos_str.split(":")
    delet, insert = mod.split("/")
    # window on the (possibly cluster-clipped) target, 0-based
    pos = int(start) - 1 - int(row.start_off)
    end = int(stop) - 2 - int(row.start_off)
    ref_seq = row.ref_seq_raw.upper()

    if not delet and insert:
        handler = _resolve_insertion
    elif row.type_ == "Deletion":
        handler = _resolve_deletion
    elif row.type_ == "Substitution":
        handler = _resolve_substitution
    elif row.type_ == "Indel":
        handler = _resolve_indel
    else:
        sys.stderr.write("WARNING: This variant isn't taken account\n")
        sys.stderr.write(" - variant: " + str(row.type_) + "\n")
        return None
    return handler(row, gm, pos, end, delet, insert, ref_seq, mod)


def create_report(args):
    if args.format == "vcf" and args.info == "cluster":
        sys.exit("ERROR: -f vcf and -i cluster options are incompatible")

    vcf = args.format == "vcf"
    table_mode = args.format == "table"
    variants: dict = {}
    samples: dict = {}
    data: dict = {}

    gm = GenomeMap(args.target)

    exclu_table = None
    if args.exclu != "":
        exclu_table = load_table(args.exclu)

    if vcf:
        _vcf_header()
    elif not table_mode:
        _emit(_REPORT_COLUMNS)

    for line in args.infile:
        if line[0] == "#":
            continue
        tok = line.strip("\n").split("\t")
        if (not re.search(args.info, line) or tok[0] == "Database"
                or len(tok) <= 1):
            continue
        row = _Row(tok)

        min_exclu = ""
        if exclu_table is not None and row.alt_seq != "":
            min_exclu = str(int(exclu_table.cover(row.alt_seq).min()))

        if int(row.min_cov) < args.min_cov:
            continue

        if row.type_ == "Reference":
            if vcf:
                continue
            if not table_mode:
                _emit([row.samp, gm.whole_region(), "-", row.type_, "0",
                       "0", "0.0", row.alt_exp, row.ratio, row.min_cov,
                       min_exclu, "-", row.query, tok[-1], "", ""])
                continue
            v = _Variant(gm.whole_region(), "-", row.type_, "0", "0",
                         "", "", "", 0, 0)
        else:
            v = _resolve(row, gm)
            if v is None:
                sys.stderr.write(" - line: " + line)
                sys.exit()
            if vcf and v.split_across_exons:
                # deletions skip silently, like km (find_report.py:248)
                if row.type_ != "Deletion":
                    sys.stderr.write("NOTE: Mutation overlaps 2 exons or "
                                     "more, VCF output is disabled \n")
                continue

        if vcf:
            ref_allele, alt_allele = v.ref_allele, v.alt_allele
            if gm.minus:
                ref_allele = ref_allele.translate(_COMPLEMENT)[::-1]
                alt_allele = alt_allele.translate(_COMPLEMENT)[::-1]
            _emit([gm.chro, str(v.loc), ".", ref_allele, alt_allele,
                   ".", ".",
                   "TYPE=" + v.type_ + ";TARGET=" + row.query +
                   ";RATIO=" + row.ratio + ";MINCOV=" + row.min_cov +
                   ";REMOVED=" + v.removed +
                   ";ADDED=" + v.added.replace(" ", "")])
        elif table_mode:
            var_name = (row.type_ + "/" + row.query
                        if "/" not in row.type_ else row.type_)
            key = (var_name,
                   v.region + ":" + v.variant if v.variant else v.region)
            variants[key] = variants.get(key, 0) + 1
            samples.setdefault(row.samp, set()).add(key)
            data.setdefault(row.samp, {})[key] = float(row.ratio)
        else:
            _emit([row.samp, v.region, v.location, v.type_, v.removed,
                   v.added, row.alt_exp, row.ref_exp, row.ratio,
                   row.min_cov, min_exclu, v.variant, row.query, row.info,
                   row.alt_seq, row.ref_seq_raw])

    if table_mode:
        _print_table(variants, samples, data)


def _print_table(variants, samples, data):
    """rVAF pivot: variants (most recurrent first) as columns, samples
    as rows; Reference columns keep their name, mutation columns show
    region:variant; absent or zero mutation cells print '.'."""
    order = sorted(variants, key=variants.get, reverse=True)
    header = ["Sample"] + [name if name.split("/")[0] == "Reference"
                           else where for name, where in order]
    sys.stdout.write("\t".join(header) + "\n")
    for samp, seen in samples.items():
        cells = [samp]
        for key in order:
            if key not in seen:
                cells.append(".")
            elif "Reference" not in key[0] and not data[samp][key]:
                cells.append(".")
            else:
                cells.append(str(data[samp][key]))
        sys.stdout.write("\t".join(cells) + "\n")


def main_find_report(args, argparser):
    if args.infile.isatty() or args.target is None:
        argparser.print_help()
        sys.exit()
    create_report(args)
