"""Per-language conjunction and comma tables for subtitle splitting.

Linguistic data parity with reference whisperx/conjunctions.py:6-47 (same
language inventory and split-word sets), stored as sorted tuples.
"""

from typing import Set

# fmt: off
_CONJUNCTIONS = {
    "en": ("across", "after", "although", "and", "as", "because", "before",
           "both", "but", "either", "even", "for", "how", "if", "near",
           "neither", "nor", "once", "or", "since", "so", "than", "that",
           "though", "through", "unless", "until", "when", "whereas",
           "whether", "which", "while", "who", "where", "what", "yet"),
    "fr": ("aussitôt", "avant", "après", "bien", "comme", "donc", "dès",
           "encore", "et", "jusqu’à", "lorsque", "mais", "malgré", "ni",
           "ou", "où", "parce", "pendant", "puisque", "quand", "que", "si",
           "soit", "tant", "à"),
    "de": ("aber", "also", "außer", "bevor", "bis", "dass", "indem",
           "jedoch", "nachdem", "obwohl", "oder", "sobald", "sowie",
           "sowohl", "trotzdem", "und", "weder", "weil", "wenn", "wie",
           "während", "wo", "zwar"),
    "es": ("a", "antes", "aunque", "como", "cuando", "después", "donde",
           "hasta", "mientras", "ni", "o", "pero", "por", "porque", "que",
           "si", "sin", "sino", "tan", "y", "ya"),
    "it": ("a", "anche", "appena", "che", "cioè", "come", "dopo", "dove",
           "e", "fino", "ma", "mentre", "nonostante", "né", "o", "ossia",
           "perché", "poiché", "prima", "quando", "quindi", "se"),
    "ja": ("かつ", "しかし", "そして", "それとも", "それに", "それゆえに",
           "そのため", "ため", "だから", "なぜなら", "なのに", "ならば",
           "もし", "もしくは", "または"),
    "zh": ("不但", "不过", "也", "任何", "但是", "虽然", "和", "因为",
           "因此", "如果", "所以", "既然", "即使", "尽管", "直到", "然后",
           "而且", "而是", "只要", "除非", "或"),
    "nl": ("als", "dat", "dus", "echter", "en", "hoewel", "maar", "nadat",
           "noch", "of", "omdat", "ondanks", "tenzij", "terwijl", "toch",
           "totdat", "voordat", "waar", "wanneer", "zoals", "zodra",
           "zowel"),
    "uk": ("або", "але", "ані", "бо", "де", "доки", "коли", "незважаючи",
           "перш", "після", "поки", "та", "тому", "хоча", "що", "як",
           "якщо"),
    "pt": ("a", "antes", "apesar", "assim", "até", "como", "depois", "e",
           "embora", "enquanto", "já", "mas", "nem", "onde", "ou", "pois",
           "porque", "portanto", "quando", "que", "se", "senão"),
    "ar": ("أو", "إذا", "إلا", "الذي", "بعد", "بما", "بينما", "حتى", "حيث",
           "رغم", "عندما", "فور", "قبل", "كما", "لأن", "لذلك", "لكن", "مع",
           "و"),
    "cs": ("a", "ale", "ani", "ačkoli", "dokud", "jakmile", "jako", "když",
           "kde", "navzdory", "nebo", "než", "pokud", "pokud ne", "poté",
           "protože", "stejně", "tak", "tudíž", "zatímco", "že"),
    "ru": ("где", "зато", "и", "или", "как", "когда", "несмотря", "ни",
           "но", "перед", "пока", "после", "потому", "также", "таким",
           "хотя", "что", "если"),
    "pl": ("a teraz", "ale", "ani", "chociaż", "chyba", "czyli", "dopóki",
           "gdzie", "i", "jak", "jak tylko", "jeśli", "kiedy", "lub",
           "po", "podczas", "pomimo", "ponieważ", "tak", "więc", "zanim",
           "że"),
    "hu": ("aho", "ahogy", "ahol", "amikor", "amint", "amíg", "de",
           "ellenére", "ha", "habár", "hacsak", "hogy", "mert", "mielőtt",
           "miután", "míg", "sem", "tehát", "vagy", "vagyis", "és", "úgy"),
    "fi": ("eikä", "ellei", "ennen", "että", "heti", "huolimatta", "ja",
           "jos", "koska", "kun", "kunnes", "kuten", "missä", "mutta",
           "sekä", "sen jälkeen", "siis", "tai", "vaan", "vaikka"),
    "fa": ("اگر", "اگرچه", "اما", "با وجود", "به محض", "تا زمانی", "پس",
           "چون", "چگونه", "در حالی", "قبل", "مگر", "نه", "همچنین", "و",
           "وقتی", "که", "کجا", "یا"),
    "el": ("αλλά", "αν", "αφού", "δηλαδή", "εκτός", "ενώ", "επειδή",
           "έτσι", "και", "μέχρι", "μόλις", "όπου", "όπως", "όταν",
           "ούτε", "παρά", "που", "προτού", "ή"),
    "tr": ("ama", "çünkü", "eğer", "hem", "her ne", "iken", "kadar", "ki",
           "nasıl", "ne", "nerede", "önce", "rağmen", "sonra", "hemen",
           "ve", "veya", "yani"),
    "da": ("altså", "at", "efter", "eller", "fordi", "før", "hverken",
           "hvis", "hvor", "indtil", "ligesom", "medmindre", "men", "mens",
           "når", "og", "om", "selvom", "som", "således"),
    "he": ("אבל", "או", "אחרי", "אלא", "אם", "אף", "ברגע", "בזמן", "היכן",
           "ו", "כאשר", "כי", "כיצד", "כמו", "לא", "אז", "למרות", "לכן",
           "לפני", "עד", "ש"),
    "vi": ("bởi", "cho", "cũng", "giống", "hoặc", "khi", "mặc", "như",
           "nhưng", "nếu", "ngay", "rằng", "sau", "trong", "trước", "trừ",
           "tức", "và", "vì", "ở"),
    "ko": ("거나", "게다가", "결국", "고", "그", "그래도", "그래서", "그러나",
           "그런데", "그럼에도", "그렇기", "그리고", "까지", "덧붙이자면",
           "도", "동안", "따라서", "때문에", "랑", "마지막으로", "마찬가지로",
           "만약", "무엇", "반면에", "불구하고", "비록", "아니라면", "아니면",
           "어디서", "어떻게", "언제", "왜냐하면", "이나", "전에", "즉시",
           "같은", "또는", "하지만", "한다면", "후에"),
    "ur": ("اس لئے", "اگر", "اگر نہیں تو", "اگرچہ", "اور", "تک", "جب",
           "جبکہ", "جیسے", "جیسے ہی", "سے پہلے", "مگر", "نہ", "کس طرح",
           "کہ", "کہاں", "کیونکہ", "کے باوجود", "کے بعد", "یا"),
    "hi": ("अगर", "और", "एक", "कैसे", "क्या", "जबकि", "जहां", "जो", "तक",
           "तो", "दोनों", "न", "नजदीक", "पर", "पहले", "पार", "फिर", "बाद",
           "माध्यम", "या", "यहां", "वह", "से", "हालांकि", "के", "चूंकि"),
}
# fmt: on

_COMMAS = {"ja": "、", "zh": "，", "fa": "،", "ur": "،"}


def get_conjunctions(lang_code: str) -> Set[str]:
    return set(_CONJUNCTIONS.get(lang_code, ()))


def get_comma(lang_code: str) -> str:
    return _COMMAS.get(lang_code, ",")
