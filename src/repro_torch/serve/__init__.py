"""Request scheduling for the conv serving tier."""
