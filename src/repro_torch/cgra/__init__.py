"""The switch CGRA device model (:mod:`.device`); the mapper is not ported
yet."""
