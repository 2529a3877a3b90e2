"""shotgun_tpu: a JAX shotgun-metagenomics pseudo-alignment engine.

A from-scratch rebuild of the capabilities of
nyenyu12/BioInformatics-project-for-Shotgun-Metagenomics-Pseudo-alignment-shotgun-
designed for JAX/XLA on an accelerator: 2-bit packed k-mers, a sort-merge
probe and a bucketized hash table in device memory, a vectorized probe +
classify pipeline under ``jit``, and data-parallel scaling via
``jax.sharding``.

Public API mirrors the reference's: FASTAFile/FASTAQFile, KmerReference,
Read.pseudo_align, PseudoAlignment, plus the same 4 CLI tasks.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy imports keep `import shotgun_tpu` light (no jax import)
    if name in ("FASTAFile", "FASTAQFile", "InvalidExtensionError",
                "NoRecordsInDataFile"):
        from shotgun_tpu.io import data_file
        return getattr(data_file, name)
    if name in ("KmerReference", "KDBFormatError", "reverse_complement",
                "extract_kmers_from_genome"):
        from shotgun_tpu import reference
        return getattr(reference, name)
    if name in ("PseudoAlignment", "Read", "ReadMappingType", "KmerSpecifity",
                "ReadKmer", "ReadMapping", "AddingExistingRead",
                "NotValidatingUniqueMapping"):
        from shotgun_tpu import aligner
        return getattr(aligner, name)
    raise AttributeError(f"module 'shotgun_tpu' has no attribute {name!r}")
