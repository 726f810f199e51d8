"""The benchmark's plain reference: float32 Whisper, the front end and the
decoding rules, and for a configuration that aligns float32 wav2vec2-CTC
and WhisperX's trellis and backtrack, written again from their published
semantics. It imports nothing of the program under test."""
