"""Core physics of the reactor: constants, thermodynamics, chemistry,
transport, stratification and the integrated multi-zone CSTR."""
