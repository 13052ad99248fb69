"""Place recognition: the BoW vocabulary and the keyframe database."""
