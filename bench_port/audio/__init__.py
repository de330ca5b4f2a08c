"""One module per kind of audio, named by a traffic mix's ``audio``:
``make(lengths, sr, gen, device) -> Tensor``, a ``(B, max(lengths))``
float32 batch on ``device`` made from the generator ``gen``, zero past each
clip's end."""
