"""Out-of-codec tools (reference tools/: ply-merge etc.)."""
