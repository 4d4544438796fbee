"""English stop-word list.

The Glasgow Information Retrieval Group public stop-word list
(http://ir.dcs.gla.ac.uk/resources/linguistic_utils/stop_words),
plus the contraction forms the reference pipeline filters
(utils/stop_words.py:16-52) so remove_stop_words behaves identically.

A copy of mmt_tpu/data/stop_words.py (the port imports nothing of the JAX
package).
"""

ENGLISH_STOP_WORDS = frozenset((
    "a", "about", "above", "across", "actually", "after", "afterwards",
    "again", "against", "all", "almost", "alone", "along", "already", "also",
    "although", "always", "am", "among", "amongst", "amoungst", "amount", "an",
    "and", "another", "any", "anyhow", "anyone", "anything", "anyway",
    "anywhere", "are", "around", "as", "at", "back", "be", "became", "because",
    "become", "becomes", "becoming", "been", "before", "beforehand", "behind",
    "being", "below", "beside", "besides", "better", "between", "beyond",
    "bill", "bit", "both", "bottom", "but", "by", "call", "can", "can't",
    "cannot", "cant", "co", "con", "could", "couldnt", "cry", "de", "describe",
    "detail", "did", "different", "different", "do", "does", "doesn't",
    "don't", "done", "down", "due", "during", "each", "easy", "eg", "eight",
    "either", "eleven", "else", "elsewhere", "empty", "enough", "etc", "even",
    "ever", "every", "everyone", "everything", "everywhere", "except", "few",
    "fifteen", "fifty", "find", "fire", "first", "five", "for", "former",
    "formerly", "forty", "found", "four", "from", "further", "give", "going",
    "gonna", "great", "guys", "had", "has", "hasnt", "have", "he", "hence",
    "her", "here", "hereafter", "hereby", "herein", "hereupon", "hers",
    "herself", "hey", "him", "himself", "his", "hope", "how", "however",
    "hundred", "i", "i'll", "i'm", "i've", "ie", "if", "in", "inc", "indeed",
    "interest", "is", "it", "it'll", "it's", "its", "itself", "just", "keep",
    "kind", "know", "last", "latter", "latterly", "least", "less", "let",
    "let's", "like", "look", "looks", "ltd", "made", "many", "may", "maybe",
    "me", "meanwhile", "might", "mill", "mine", "more", "moreover", "most",
    "mostly", "much", "must", "my", "myself", "name", "namely", "need",
    "neither", "never", "nevertheless", "next", "nine", "no", "nobody", "none",
    "noone", "nor", "not", "nothing", "now", "nowhere", "of", "off", "often",
    "oh", "ok", "okay", "on", "once", "one", "only", "onto", "or", "other",
    "others", "otherwise", "our", "ours", "ourselves", "out", "over", "own",
    "part", "per", "perhaps", "please", "probably", "put", "rather", "re",
    "really", "right", "same", "say", "see", "seem", "seemed", "seeming",
    "seems", "serious", "several", "she", "should", "show", "side", "since",
    "sincere", "six", "sixty", "so", "some", "somehow", "someone", "something",
    "sometime", "sometimes", "somewhere", "still", "such", "sure", "take",
    "ten", "than", "thank", "thanks", "that", "that's", "the", "their", "them",
    "themselves", "then", "thence", "there", "there's", "thereafter",
    "thereby", "therefore", "therein", "thereupon", "these", "they", "they're",
    "third", "this", "those", "though", "three", "through", "throughout",
    "thru", "thus", "to", "today", "together", "too", "top", "toward",
    "towards", "try", "twelve", "twenty", "two", "um", "un", "until", "up",
    "upon", "us", "very", "via", "video", "view", "viewer", "viewing", "want",
    "was", "we", "we'll", "we're", "we've", "welcome", "well", "were", "what",
    "whatever", "when", "whence", "whenever", "where", "whereafter", "whereas",
    "whereby", "wherein", "whereupon", "wherever", "whether", "which", "while",
    "whither", "who", "whoever", "whole", "whom", "whose", "why", "will",
    "with", "within", "without", "won't", "wont", "would", "yeah", "yet",
    "you", "you'll", "you're", "you've", "your", "yours", "yourself",
    "yourselves", "youtube",
))
