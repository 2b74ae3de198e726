"""IO: native readers for Jellyfish .jf count tables, FASTA targets and
FASTQ reads. No external Jellyfish dependency anywhere."""
