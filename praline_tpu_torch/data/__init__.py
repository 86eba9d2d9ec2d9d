"""Packaged data: substitution matrices (see ``matrices/``).

``blosum62.txt`` is the exact standard NCBI BLOSUM62 table.  ``blosum50.txt``
and ``pam250.txt`` were reconstructed offline and are flagged as such in their headers;
``dna_simple.txt`` is a simple NUC.4.4-style match/mismatch scheme.  Custom
matrices in the same text format load via
``praline_tpu_torch.io.load_score_matrix``.  The files are copies of the JAX
package's ``praline_tpu/data/matrices``.
"""
