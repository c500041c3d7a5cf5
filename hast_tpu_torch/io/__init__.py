"""Host input: fastq/fasta readers and the native libhastio binding."""
