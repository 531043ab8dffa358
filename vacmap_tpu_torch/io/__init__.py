"""Read and write FASTA/FASTQ, SAM and BAM; merge per-process SAM parts."""
