"""Stage 01: classify, barcode splits and fastq quartering."""
