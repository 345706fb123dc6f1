"""Export and generate: the `.rtpu` artifact, its step programs, batch re-synthesis."""
