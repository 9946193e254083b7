"""The roofline of a dry-run cell on the H100 (:mod:`analysis`)."""
