"""The reference-syntax (tmc3) pieces the native-syntax codec uses."""
