"""Template sampling and the text->image task of the port."""
