"""The benchmark's plain reference: float32 Whisper, the front end and the
decoding rules, written again from their published semantics. It imports
nothing of the program under test."""
