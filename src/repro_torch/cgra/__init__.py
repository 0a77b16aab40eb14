"""The switch CGRA: the device model (:mod:`.device`) and the mapper that
places stage bodies on it (:mod:`.mapper`, imported by the compiler's
PlaceCGRA pass when it runs)."""
